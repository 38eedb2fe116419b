#!/usr/bin/env python3
"""Time the hash build and the fused pipeline's dictionary and Reduce
terminals of the ``repro_torch`` that is first on ``sys.path``, on one CUDA
card, at the shapes of the port's main paths; print one JSON line.

    PYTHONPATH=src python3 tools/terminal_timings.py record --calls DIR
    PYTHONPATH=src python3 tools/terminal_timings.py time --calls DIR [--label NAME] [--path P]

``record`` runs TPC-H q1, q3 and q18 through ``repro_torch.connect(db)`` at
SF 1 (resident) and through ``connect(db, memory_budget=B,
chunk_rows=1,048,576)`` at SF 10 (lineitem streamed: every other relation's
decoded bytes make the budget, as ``chip_smoke.py`` sets it), and saves the
fused-pipeline calls of each warm query: every launch at SF 1, and one fold
at SF 10 (the middle chunk's ``init=`` launch of each streamed region, with
its carried accumulator as it was before the launch).  ``time`` loads them
back onto the card and times each call, then times the hash build on
synthetic data made on the card from ``--seed``:

* TPC-H SF 1's build: its 1,500,000 orderkeys (the first 8 of every 32
  integers, as ``dbgen`` makes them), V = 1, into C = 4,194,304, shuffled,
  and SF 10's: 15,000,000 into C = 33,554,432 (a table larger than L2);
* the installation sweep's insert cells (the profiler's draws: ``size``
  distinct keys of 1 .. 8·size into ``next_pow2(2·size)`` slots, at least
  256, V = 1): the distinct batches at 2^17 .. 2^21 keys, and the
  duplicate-heavy batches of ``min(size·dup, 2^18)`` rows at 16 .. 65,536
  keys (``dup`` 4, 16, 64 and, up to 256 keys, 1,024 and 8,192), ordered
  and shuffled.

Two checkouts compare by running ``time`` once with each one's ``src`` on
``PYTHONPATH``, in one run on one card (A, B, B, A), over one recording:
the wrappers' signatures are the same in every checkout since the kernels
were first ported.  ``--path`` makes this tree's hash build take one path
at every shape where the path's shared memory fits (its ``build_path``
rule elsewhere).  ``--unchecked`` times
without holding each result against its plain twin first (for a kernel
altered on purpose to see what a part of it costs).

Each result is held against its plain twin first (key sets equal, values
within rtol=3e-3, atol=3e-2).  Times are device milliseconds a call: the
stream sleeps while the host queues ``--reps`` calls, CUDA events time them
back to back; the median of three such rounds.  A fold (``init=``) folds
into its recorded state again each call, as ``chip_smoke.py`` times it: the
same rows, with every key of the chunk claimed after the first call.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

RTOL, ATOL = 3e-3, 3e-2
EMPTY = -(2**31)
QUERIES = ("q1", "q3", "q18")
OOC_CHUNK_ROWS = 1 << 20


def device_ms(fn, reps):
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


def kernel_split(fn):
    """``{kernel: device ms}`` of one call of ``fn`` (after a warm-up), from
    the profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def tree_map(obj, fn):
    """``obj`` with every tensor in it replaced by ``fn(tensor)`` (tuples,
    named tuples, lists and dicts rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_map(x, fn) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(x, fn) for x in obj)
    if isinstance(obj, dict):
        return {k: tree_map(v, fn) for k, v in obj.items()}
    return obj


def same_dicts(got, want, what):
    """Equal key sets, values within the tolerance; max |err|."""
    def items(acc):
        keys, vals = acc
        keys, vals = keys.reshape(-1), vals.reshape(keys.numel(), -1)
        live = keys != EMPTY
        ks, vs = keys[live], vals[live]
        order = ks.argsort()
        return ks[order], vs[order]

    gk, gv = items(got)
    wk, wv = items(want)
    if not (gk.shape == wk.shape and bool((gk == wk).all())):
        raise SystemExit(f"terminal_timings: {what}: key sets differ from the plain twin "
                         f"({gk.numel()} vs {wk.numel()} keys)")
    if not wk.numel():
        return 0.0
    diff = (gv - wv).abs()
    if not bool(((diff <= ATOL + RTOL * wv.abs()) | (gv == wv)).all()):
        raise SystemExit(f"terminal_timings: {what}: values differ from the plain twin by {float(diff.max())}")
    return float(diff.masked_fill(gv == wv, 0.0).max())


# ---------------------------------------------------------------------------
# record
# ---------------------------------------------------------------------------


def record(calls_dir, scale, ooc_scale, seed):
    import repro_torch
    from repro_torch.data import tpch
    from repro_torch.data.table import collect_stats
    from repro_torch.kernels import fused_pipeline as fp

    dev = torch.device("cuda:0")
    os.makedirs(calls_dir, exist_ok=True)
    real = fp.fused_pipeline
    log = []

    def rec(*args, **kw):
        log.append((args, kw))
        return real(*args, **kw)

    def save(name, entries):
        torch.save(tree_map(entries, lambda t: t.cpu()), os.path.join(calls_dir, f"{name}.pt"))

    t0 = time.perf_counter()
    db = tpch.generate(scale=scale, seed=seed, device=dev).tables()
    session = repro_torch.connect(db, device=dev)
    for q in QUERIES:
        session.query(q)  # cold: plans and builds the regions
        log.clear()
        fp.fused_pipeline = rec
        try:
            session.query(q)
        finally:
            fp.fused_pipeline = real
        save(f"sf{scale:g}_{q}", [(f"{q} SF {scale:g} launch {k}", args, kw) for k, (args, kw) in enumerate(log)])
        print(f"recorded {q} at SF {scale:g}: {len(log)} fused launches", flush=True)
    del db, session
    torch.cuda.empty_cache()
    print(f"SF {scale:g} recorded in {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    db = tpch.generate(scale=ooc_scale, seed=seed, device=dev).tables()
    sigma = collect_stats(db)
    budget = int(sum(4 * st.rows * len(st.columns) for rel, st in sigma.rels.items() if rel != "lineitem"))
    oo = repro_torch.connect(db, device=dev, memory_budget=budget, chunk_rows=OOC_CHUNK_ROWS)
    print(f"SF {ooc_scale:g} generated and chunked in {time.perf_counter() - t0:.1f}s", flush=True)
    n_chunks = oo.db["lineitem"].n_chunks
    for q in QUERIES:
        seen, entries = {}, []

        def fold(*args, **kw):  # keeps the middle chunk's launch of each streamed region
            if kw.get("init") is not None:
                region = (args[0].term, args[0].out)
                k = seen[region] = seen.get(region, -1) + 1
                if k == n_chunks // 2:
                    entries.append((f"{q} SF {ooc_scale:g} fold {len(entries)} (chunk {k} of {n_chunks})",
                                    *tree_map((args, kw), lambda t: t.clone())))
            return real(*args, **kw)

        fp.fused_pipeline = fold
        try:
            oo.query(q)
        finally:
            fp.fused_pipeline = real
        save(f"sf{ooc_scale:g}_{q}", entries)
        print(f"recorded {q} at SF {ooc_scale:g}: {len(entries)} folds", flush=True)
        del entries
    return 0


# ---------------------------------------------------------------------------
# time
# ---------------------------------------------------------------------------


def sweep_cells(gen, dev):
    """``(what, keys, vals, capacity)`` of every timed hash-build shape."""
    i = torch.arange(1_500_000, device=dev)
    okeys = ((i // 8) * 32 + i % 8 + 1).to(torch.int32)
    okeys = okeys[torch.randperm(okeys.shape[0], generator=gen, device=dev)]
    yield "SF 1 orderkeys (n=1500000, C=4194304)", okeys, torch.ones((okeys.shape[0], 1), device=dev), 4_194_304
    i = torch.arange(15_000_000, device=dev)
    okeys = ((i // 8) * 32 + i % 8 + 1).to(torch.int32)
    okeys = okeys[torch.randperm(okeys.shape[0], generator=gen, device=dev)]
    yield "SF 10 orderkeys (n=15000000, C=33554432)", okeys, torch.ones((okeys.shape[0], 1), device=dev), 33_554_432
    del okeys, i

    def draw(size):
        present = (torch.randperm(8 * size - 1, generator=gen, device=dev)[:size] + 1).to(torch.int32)
        return present, 1 << (max(2 * size, 256) - 1).bit_length()

    for size in (2**17, 2**18, 2**19, 2**20, 2**21):
        present, cap = draw(size)
        vals = torch.randn((size, 1), generator=gen, device=dev)
        yield f"sweep distinct 2^{size.bit_length() - 1} shuffled (n={size}, C={cap})", present, vals, cap
        yield f"sweep distinct 2^{size.bit_length() - 1} ordered (n={size}, C={cap})", torch.sort(present).values, vals, cap
    for size in (16, 64, 256, 1024, 4096, 16384, 65536):
        present, cap = draw(size)
        for dup in (4, 16, 64) + ((1024, 8192) if size <= 256 else ()):
            n = min(size * dup, 2**18)
            ks = present[torch.randint(0, size, (n,), generator=gen, device=dev)]
            vals = torch.randn((n, 1), generator=gen, device=dev)
            yield f"sweep dup x{dup} into 2^{size.bit_length() - 1} shuffled (n={n}, C={cap})", ks, vals, cap
            yield f"sweep dup x{dup} into 2^{size.bit_length() - 1} ordered (n={n}, C={cap})", \
                torch.sort(ks).values, vals, cap


def time_calls(calls_dir, label, path, reps, seed, checked):
    from repro_torch.dicts import ht_linear
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.kernels import hash_build as hb

    if path is not None:
        if not hasattr(hb, "build_path"):
            raise SystemExit("terminal_timings: --path needs a hash build with build_path")
        rule = hb.build_path

        def forced(n, C, V, sms, l2):  # the path where its shared memory allows it
            fits = {"global": True, "private": C * (1 + V) * 4 <= fp.STAGE_BYTES,
                    "partitioned": C // hb.slice_slots(C, V, sms) <= hb.MAX_SLICES}
            return path if fits[path] else rule(n, C, V, sms, l2)

        hb.build_path = forced
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    fused = []
    for name in sorted(os.listdir(calls_dir)) if calls_dir else ():
        if not name.endswith(".pt"):
            continue
        entries = torch.load(os.path.join(calls_dir, name), weights_only=False)  # written by `record`
        for what, args, kw in entries:
            args, kw = tree_map((args, kw), lambda t: t.to(dev))
            err = None
            if checked:
                kw_k = kw if kw.get("init") is None else dict(kw, init=tuple(t.clone() for t in kw["init"]))
                got = fp.fused_pipeline(*args, **kw_k)
                want = fp.fused_pipeline_plain(*args, **kw)
                if args[0].out[0] == "dict":
                    err = same_dicts(got, want, what)
                else:
                    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
                    err = float((got - want).abs().max())
                del got, want, kw_k
            nbytes, nops = fp.roofline(*args, **kw)
            ms = device_ms(lambda: fp.fused_pipeline(*args, **kw), reps)
            out = args[0].out
            fused.append({"call": what, "term": args[0].term[0], "out": [out[0], *out[2:4]] if out[0] == "dict" else list(out[:2]),
                          "rows": int(args[2].shape[0]), "ms": ms, "bytes": nbytes, "ops": nops, "max_abs_err": err})
            print(f"{label} fused {what} ({fused[-1]['term']}, out {fused[-1]['out']}, {fused[-1]['rows']} rows): "
                  f"{ms:.4f} ms", flush=True)
            del args, kw
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(seed)
    builds = []
    P = ht_linear.MAX_PROBES
    for what, keys, vals, cap in sweep_cells(gen, dev):
        err = None
        if checked:
            err = same_dicts(hb.hash_build(keys, vals, cap, P), hb.hash_build_plain(keys, vals, cap, P), what)
        before = hb.hash_build.launches
        hb.hash_build(keys, vals, cap, P)
        launches = hb.hash_build.launches - before
        ms = device_ms(lambda: hb.hash_build(keys, vals, cap, P), reps)
        split = kernel_split(lambda: hb.hash_build(keys, vals, cap, P)) if what.startswith("SF") else None
        path_of = getattr(hb, "build_path", None)
        props = torch.cuda.get_device_properties(dev)
        builds.append({"shape": what, "n": int(keys.shape[0]), "C": cap, "ms": ms, "launches": launches,
                       "path": path_of(keys.shape[0], cap, 1, props.multi_processor_count, props.L2_cache_size)
                       if path_of else None,
                       "bytes": int(keys.shape[0]) * 8 + cap * 8, "max_abs_err": err, "kernels": split})
        print(f"{label} hash_build {what}: {ms:.4f} ms ({launches} launches, path {builds[-1]['path']})"
              + (f"; by kernel {split}" if split else ""), flush=True)
    print(json.dumps({"label": label, "path": path, "card": card[0] if card else None, "checked": checked,
                      "fused": fused, "hash_build": builds}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("step", choices=("record", "time"))
    ap.add_argument("--calls", default=None, help="directory of the recorded fused-pipeline calls "
                    "(time: none, the hash build alone)")
    ap.add_argument("--label", default="")
    ap.add_argument("--path", default=None, help="the hash build's path at every shape")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--ooc-scale", type=float, default=10.0)
    ap.add_argument("--unchecked", action="store_true", help="do not hold results against the plain twins")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("terminal_timings: no CUDA device")
    if args.step == "record":
        if args.calls is None:
            raise SystemExit("terminal_timings: record needs --calls")
        return record(args.calls, args.scale, args.ooc_scale, 7)
    return time_calls(args.calls, args.label, args.path, args.reps, args.seed, not args.unchecked)


if __name__ == "__main__":
    raise SystemExit(main())
