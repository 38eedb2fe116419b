#!/usr/bin/env python3
"""Time the hash probe and the decode of the ``repro_torch`` that is first
on ``sys.path``, on one CUDA card, at the shapes of the port's main paths;
print one JSON line.

    PYTHONPATH=src python3 tools/probe_decode_timings.py record --calls DIR
    PYTHONPATH=src python3 tools/probe_decode_timings.py time [--calls DIR] [--label NAME] [--path P]

``record`` streams TPC-H SF 10 through ``connect(db, memory_budget=B,
chunk_rows=1,048,576)`` (lineitem streamed: every other relation's decoded
bytes make the budget, as ``chip_smoke.py`` sets it), runs the five queries
cold, then once warm with every decode call recorded, and saves one call of
each (kind, bits, dtype, rows) signature with its count, and how many
encoded columns each chunk decode asked for.  ``time`` loads them back onto
the card and times each signature, then the synthetic kinds of
``chip_smoke.py`` phase 10 (every encoding and bit width at a
1,048,576 − 17-row chunk padded to 1,048,576 rows; the 8- and 16-bit
bitpack chunks also unpadded, beside the one PyTorch call that decodes
them: the words viewed as uint8 / uint16 and cast), then the hash probe on
synthetic data made on the card from ``--seed``:

* TPC-H SF 1's shape: its 1,500,000 orderkeys (the first 8 of every 32
  integers, as ``dbgen`` makes them) in C = 4,194,304 slots, V = 1 and
  V = 3, under 6,000,000 lineitem orderkeys (1 to 7 a key) in lineitem
  order and shuffled;
* the installation sweep's lookup cells (``costmodel/profiler.py``'s
  draws: ``size`` distinct keys of 1 .. 8·size in ``next_pow2(max(2·size,
  256))`` slots, n = size × 0.25, 1 and 4 probes of present keys or of
  absent ones, ordered and shuffled) at 2^10, 2^14, 2^17, 2^19 and 2^21
  keys.

Tables are built by the plain twin, so every checkout probes the same slot
layout.  Each probe shape is timed in two L2 states: ``warm`` (calls back
to back) and ``cold`` (a 100 MB write before each call evicts the table;
only the probe is timed).  The sweep's cells also give ``host_ms``, the
median wall of a call that ends in ``torch.cuda.synchronize()``, as the
profiler times them.  ``--path`` makes this tree's hash probe take one of
its paths at every shape (where it has ``probe_path``).

Two checkouts compare by running ``time`` once with each one's ``src`` on
``PYTHONPATH``, in one run on one card (A, B, B, A), over one recording:
the wrappers' signatures are the same in every checkout since the kernels
were first ported.  ``--unchecked`` times without holding each result
against its plain twin first (for a kernel altered on purpose to see what
a part of it costs).  ``--set NAME=VALUE`` (repeatable) rebuilds this
tree's kernels with a ``constexpr`` constant of ``csrc/hash_probe.cu`` or
``csrc/decode.cu`` set to another value (the design choices the kernels
name there: ``THREADS``, ``RLE_THREADS``, ``BLOCKS_PER_SM``); ``--states warm`` skips the evicted-table timings.

Results are held against the plain twins bit for bit first.  Times are
device milliseconds a call: the stream sleeps while the host queues
``--reps`` calls, CUDA events time them; the median of three such rounds.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import time
from collections import Counter

import numpy as np
import torch

OOC_CHUNK_ROWS = 1 << 20
SWEEP_SIZES = (2**10, 2**14, 2**17, 2**19, 2**21)
RATIOS = (0.25, 1.0, 4.0)
HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 100 * 2**20


def device_ms(fn, reps):
    """Device ms of one call, calls back to back behind a device sleep."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000 * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(end) / reps)
    return statistics.median(rounds)


def cold_ms(fn, flush, reps):
    """Device ms of one call made after ``flush`` (a 100 MB write) has
    evicted its inputs from L2; only the call is timed."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(2_000_000 * reps)
        for start, end in evs:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        rounds.append(sum(s.elapsed_time(e) for s, e in evs) / reps)
    return statistics.median(rounds)


def host_ms(fn, reps=5):
    """Median wall ms of a call that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def card_name():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return out[0] if out else None


def to_dev(payload, dev):
    return {k: v.to(dev) for k, v in payload.items()}


# ---------------------------------------------------------------------------
# record
# ---------------------------------------------------------------------------


def record(calls_dir, ooc_scale, seed):
    import repro_torch
    from repro_torch.data import storage as STG
    from repro_torch.data import tpch
    from repro_torch.data.table import collect_stats
    from repro_torch.kernels import decode as DK

    dev = torch.device("cuda:0")
    os.makedirs(calls_dir, exist_ok=True)
    t0 = time.perf_counter()
    db = tpch.generate(scale=ooc_scale, seed=seed, device=dev).tables()
    sigma = collect_stats(db)
    budget = int(sum(4 * st.rows * len(st.columns) for rel, st in sigma.rels.items() if rel != "lineitem"))
    oo = repro_torch.connect(db, device=dev, memory_budget=budget, chunk_rows=OOC_CHUNK_ROWS)
    del db
    print(f"SF {ooc_scale:g} generated and chunked in {time.perf_counter() - t0:.1f}s", flush=True)
    queries = ("q1", "q3", "q5", "q9", "q18")
    for q in queries:
        oo.query(q)  # cold: plans and builds the regions
    print(f"cold pass done at {time.perf_counter() - t0:.1f}s", flush=True)

    real_dk, real_cd = DK.decode, STG.ChunkedTable.chunk_device
    sigs, per_chunk, by_query = {}, Counter(), Counter()
    q_now = [None]

    def rec(code, payload, rows):
        key = (code.kind, code.bits, code.dtype, rows)
        g = sigs.setdefault(key, {"count": 0, "queries": Counter(), "call": None})
        g["count"] += 1
        g["queries"][q_now[0]] += 1
        if g["call"] is None:
            g["call"] = (code, {k: v.cpu() for k, v in payload.items()}, rows)
        return real_dk(code, payload, rows)

    def counting(self, i, cols=None, pad=False, uploaded=None):
        names = tuple(cols) if cols is not None else tuple(self.chunks[i])
        k = sum(self.chunks[i][c].kind != "plain" for c in names)
        per_chunk[k] += 1
        by_query[q_now[0]] += k
        return real_cd(self, i, cols, pad, uploaded)

    DK.decode, STG.ChunkedTable.chunk_device = rec, counting
    try:
        for q in queries:
            q_now[0] = q
            oo.query(q)
    finally:
        DK.decode, STG.ChunkedTable.chunk_device = real_dk, real_cd
    entries = [(key, g["count"], dict(g["queries"]), g["call"]) for key, g in sorted(sigs.items())]
    torch.save({"signatures": entries, "columns_per_chunk_decode": dict(per_chunk),
                "decodes_by_query": dict(by_query)}, os.path.join(calls_dir, "decode_calls.pt"))
    for key, count, qs, _ in entries:
        print(f"recorded decode {key}: {count} launches a warm pass ({qs})", flush=True)
    print(json.dumps({"columns_per_chunk_decode": dict(per_chunk), "decodes_by_query": dict(by_query),
                      "signatures": [[*key, count] for key, count, _, _ in entries]}))
    return 0


# ---------------------------------------------------------------------------
# time
# ---------------------------------------------------------------------------


def synthetic_columns(rng, n):
    """``chip_smoke.py`` phase 10's columns: each encoding and bit width."""
    cols = []
    for b in (1, 2, 4, 8, 16):
        a = rng.integers(0, 1 << b, n).astype(np.int32)
        a[0] = (1 << b) - 1
        cols.append(("bitpack", a))
    cols.append(("for", (rng.integers(0, 60000, n) - 123456).astype(np.int32)))
    cols.append(("dict", rng.choice(np.array([-9, 4, 77, 1 << 28], np.int32), n)))
    cols.append(("dict", rng.choice(rng.standard_normal(300).astype(np.float32), n)))
    cols.append(("rle", np.repeat(rng.integers(-5, 5, n // 7 + 1), 7)[:n].astype(np.int32)))
    cols.append(("rle", np.repeat(rng.standard_normal(n // 300 + 1).astype(np.float32), 300)[:n]))
    return cols


def decode_library(code, payload, rows):
    """The one PyTorch call that decodes a chunk, where there is one: an 8-
    or 16-bit bitpack chunk with no padded tail."""
    if code.kind != "bitpack" or code.bits not in (8, 16) or rows != code.n:
        return None
    small = torch.uint8 if code.bits == 8 else torch.uint16
    words = payload["words"]
    return lambda: words.view(small)[:rows].to(torch.int32)


def decode_shapes(calls_dir, dev):
    """``(what, code, payload, rows, launches a pass)`` of every decode shape."""
    from repro_torch.data import storage as STG
    from repro_torch.kernels import decode as DK

    path = os.path.join(calls_dir, "decode_calls.pt") if calls_dir else None
    if path and os.path.exists(path):
        rec = torch.load(path, weights_only=False)  # written by `record`
        for (kind, bits, dtype, rows), count, _, (code, payload, _) in rec["signatures"]:
            yield f"SF 10 pass {kind} bits={bits} {dtype} (n={code.n}, rows={rows})", code, to_dev(payload, dev), rows, count
    rng = np.random.default_rng(0)
    for kind, a in synthetic_columns(rng, OOC_CHUNK_ROWS - 17):
        enc = STG.encode_column(a, mode=kind)
        payload = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in enc.payload.items()}
        code = DK.column_code(enc)
        yield (f"synthetic {kind} bits={code.bits} {code.dtype} (n={code.n}, rows={OOC_CHUNK_ROWS})",
               code, payload, OOC_CHUNK_ROWS, 0)
        if kind == "bitpack" and code.bits in (8, 16):  # unpadded too, beside its library call
            yield (f"synthetic {kind} bits={code.bits} {code.dtype} (n={code.n}, rows={code.n})",
                   code, payload, code.n, 0)


def probe_shapes(gen, dev):
    """``(what, keys, vals, queries, sweep)`` of every timed probe shape."""
    from repro_torch.dicts import base as dbase
    from repro_torch.kernels import hash_build as hb

    P = 128
    i = torch.arange(1_500_000, device=dev)
    okeys = ((i // 8) * 32 + i % 8 + 1).to(torch.int32)
    lines = torch.randint(1, 8, (okeys.shape[0],), generator=gen, device=dev)
    probes = torch.repeat_interleave(okeys, lines)[:6_000_000]
    tk, tv = hb.hash_build_plain(okeys, torch.randn((okeys.shape[0], 1), generator=gen, device=dev), 4_194_304, P)
    tv3 = torch.randn((tk.shape[0], 3), generator=gen, device=dev) * (tk != dbase.EMPTY)[:, None]
    shuffled = probes[torch.randperm(probes.shape[0], generator=gen, device=dev)]
    for V, vals in ((1, tv), (3, tv3)):
        yield f"SF 1 lineitem order (C=4194304, V={V}, n={probes.shape[0]})", tk, vals, probes, False
        yield f"SF 1 shuffled (C=4194304, V={V}, n={probes.shape[0]})", tk, vals, shuffled, False
    del tk, tv, tv3, probes, shuffled, okeys, lines, i
    for size in SWEEP_SIZES:
        perm = (torch.randperm(8 * size - 1, generator=gen, device=dev) + 1).to(torch.int32)
        present, absent = perm[:size], perm[size: 2 * size]
        cap = dbase.next_pow2(max(2 * size, 256))
        tk, tv = hb.hash_build_plain(present, torch.randn((size, 1), generator=gen, device=dev), cap, P)
        for ratio in RATIOS:
            n = max(8, int(size * ratio))
            for kind, src in (("hit", present), ("miss", absent)):
                qs = src[torch.randint(0, size, (n,), generator=gen, device=dev)]
                tag = f"sweep 2^{size.bit_length() - 1} {kind} x{ratio:g}"
                yield f"{tag} shuffled (C={cap}, n={n})", tk, tv, qs, True
                yield f"{tag} ordered (C={cap}, n={n})", tk, tv, torch.sort(qs).values, True


def rebuild(sets):
    """Rebuild the kernels whose source names a constant of ``sets``
    (``[(name, value)]``) with those constants set."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode as DK
    from repro_torch.kernels import hash_probe as hp

    used = set()
    for mod, name in ((hp, "hash_probe"), (DK, "decode")):
        src = (build.CSRC / f"{name}.cu").read_text()
        for key, value in sets:
            m = re.search(rf"constexpr (\w+) {key} = [^;]+;", src)
            if m:
                src = src.replace(m.group(0), f"constexpr {m.group(1)} {key} = {value};")
                used.add(key)
        tag = "_".join(f"{k}{v}" for k, v in sets if k in src)
        if tag:
            mod._LIB["fn"] = build.launcher(build.load(f"{name}_{tag}", src), f"{name}_launch")
    missing = {k for k, _ in sets} - used
    if missing:
        raise SystemExit(f"probe_decode_timings: no kernel names {sorted(missing)}")


def time_all(calls_dir, label, path, reps, seed, checked, only, states):
    from repro_torch.kernels import decode as DK
    from repro_torch.kernels import hash_probe as hp

    if path is not None:
        if not hasattr(hp, "probe_path"):
            raise SystemExit("probe_decode_timings: --path needs a hash probe with probe_path")
        hp.probe_path = lambda *a: path
    dev = torch.device("cuda:0")
    props = torch.cuda.get_device_properties(dev)
    decodes, probes = [], []
    if only in (None, "decode"):
        for what, code, payload, rows, count in decode_shapes(calls_dir, dev):
            if checked:
                got, want = DK.decode(code, payload, rows), DK.decode_plain(code, payload, rows)
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise SystemExit(f"probe_decode_timings: decode {what} differs from its plain twin")
            nbytes = sum(t.numel() * t.element_size() for t in payload.values()) + 4 * rows
            lib = decode_library(code, payload, rows)
            if lib is not None and checked and not torch.equal(lib(), DK.decode(code, payload, rows)):
                raise SystemExit(f"probe_decode_timings: the library call differs at {what}")
            r = {"shape": what, "kind": code.kind, "bits": code.bits, "dtype": code.dtype, "n": code.n, "rows": rows,
                 "launches_a_pass": count, "ms": device_ms(lambda: DK.decode(code, payload, rows), reps),
                 "library_ms": device_ms(lib, reps) if lib is not None else None,
                 "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
            decodes.append(r)
            print(f"{label} decode {what}: {r['ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.2f} us"
                  + (f", library {r['library_ms'] * 1e3:.2f} us" if lib is not None else "") + ")", flush=True)
            del payload
    if only in (None, "probe"):
        flush = torch.empty((FLUSH_BYTES // 4,), dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for what, tk, tv, qs, sweep in probe_shapes(gen, dev):
            C, V = tv.shape
            n = qs.shape[0]
            fn = lambda: hp.hash_probe(tk, tv, qs)  # noqa: E731
            got = fn()
            hits = int(got[1].sum())
            if checked:
                want = hp.hash_probe_plain(tk, tv, qs)
                if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
                    raise SystemExit(f"probe_decode_timings: hash_probe at {what} differs from its plain twin")
                del want
            del got
            nbytes = 4 * n + (4 * V + 1) * n + 4 * min(C, n) + 4 * V * min(C, hits)
            path_of = getattr(hp, "probe_path", None)
            r = {"shape": what, "C": C, "V": V, "n": n, "hits": hits,
                 "path": path_of(C, V, props.L2_cache_size) if path_of else None,
                 "warm_ms": device_ms(fn, reps), "cold_ms": cold_ms(fn, flush, reps) if "cold" in states else None,
                 "host_ms": host_ms(fn) if sweep else None,
                 "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
            probes.append(r)
            print(f"{label} hash_probe {what}: warm {r['warm_ms']:.4f} ms"
                  + (f", cold {r['cold_ms']:.4f} ms" if r["cold_ms"] is not None else "")
                  + (f", host {r['host_ms']:.4f} ms" if sweep else "") + f", bound {r['bound_ms']:.4f} ms"
                  + (f", path {r['path']}" if r["path"] else ""), flush=True)
    print(json.dumps({"label": label, "path": path, "card": card_name(), "checked": checked, "states": states,
                      "decode": decodes, "hash_probe": probes}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("step", choices=("record", "time"))
    ap.add_argument("--calls", default=None, help="directory of the recorded decode calls "
                    "(time: none, the synthetic decode kinds alone)")
    ap.add_argument("--label", default="")
    ap.add_argument("--path", default=None, help="the hash probe's path at every shape")
    ap.add_argument("--only", choices=("probe", "decode"), default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ooc-scale", type=float, default=10.0)
    ap.add_argument("--unchecked", action="store_true", help="do not hold results against the plain twins")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="rebuild the kernels with a constexpr constant set to VALUE")
    ap.add_argument("--states", default="warm,cold", help="L2 states of the probe timings: warm, cold or both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_decode_timings: no CUDA device")
    if args.step == "record":
        if args.calls is None:
            raise SystemExit("probe_decode_timings: record needs --calls")
        return record(args.calls, args.ooc_scale, 7)
    if args.set:
        rebuild([tuple(s.split("=", 1)) for s in args.set])
    return time_all(args.calls, args.label, args.path, args.reps, args.seed, not args.unchecked, args.only,
                    args.states.split(","))


if __name__ == "__main__":
    raise SystemExit(main())
